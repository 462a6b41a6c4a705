"""Config-level state and the compiled graph (``Topology``) of the port."""
