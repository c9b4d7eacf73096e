"""The port's numpy oracle (oracle/tracer.py)."""
