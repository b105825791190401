"""The GDELT politics benchmark on the port."""
