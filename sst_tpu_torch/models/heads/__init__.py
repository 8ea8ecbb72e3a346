"""Dense detection heads of the port."""
