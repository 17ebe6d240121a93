"""The scheduler extender: placement logic, the usage index, the webhook
server, the sharded router with its cross-shard gang 2PC, the churn
simulator, and the placement-policy registry the fleet router also uses."""
