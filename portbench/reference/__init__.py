"""The benchmark's plain float32 reference (imports only torch)."""
