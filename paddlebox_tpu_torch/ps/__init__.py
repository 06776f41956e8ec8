"""Parameter-server tiers: host table, device working set, mxu step path."""
