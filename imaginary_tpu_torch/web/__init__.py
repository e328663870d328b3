"""HTTP layer of the port (standard-library server)."""
