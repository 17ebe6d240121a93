"""The placement-policy registry the fleet router scores replicas with."""
