"""Graph, partition planner and node data of the port (counterpart of
``repro.core``)."""
