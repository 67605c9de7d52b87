"""The sharded engine: N nodes on one device, each state tensor with a
leading node axis (``sharded.py``), and the per-destination routing of
access entries between them (``routing.py``)."""
