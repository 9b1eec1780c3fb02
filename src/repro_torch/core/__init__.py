"""Graph, partition planners, mesh, sharded solvers and node data of the
port (counterpart of ``repro.core``)."""
