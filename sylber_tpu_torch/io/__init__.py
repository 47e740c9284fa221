"""Weight loading for the port."""
