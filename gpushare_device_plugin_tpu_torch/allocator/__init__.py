"""The journal and the claim ledger the port's protocols run on."""
