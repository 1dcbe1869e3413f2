"""The port of adaptigraph_tpu/sim: the simulator app (SimEnv, the xArm6
kinematics, cameras, the ray-cast renderer), the episode form and the
episode generator (data_gen)."""
