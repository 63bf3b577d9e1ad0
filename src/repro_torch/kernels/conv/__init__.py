"""Conv kernel subsystem."""
