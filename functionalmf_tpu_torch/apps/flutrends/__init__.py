"""The flu-trends benchmark on the port."""
