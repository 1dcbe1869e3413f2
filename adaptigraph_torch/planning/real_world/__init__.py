"""The real-robot layer: cameras, depth filters, shared-memory transport,
timestamps, the xArm6 driver and RealEnv (host code; no module imports
torch)."""
