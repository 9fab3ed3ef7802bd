"""Plain tensor ops of the port (geometry, sparse conv, splat packing)."""
