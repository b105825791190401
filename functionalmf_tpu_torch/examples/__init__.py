"""The reference examples on the port (run with python -m)."""
