"""The demo gallery on the port (demos/run_demos.py)."""
