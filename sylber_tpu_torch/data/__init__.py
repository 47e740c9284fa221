"""Input pipeline of the port's trainer (numpy on the host, torch on the device)."""
