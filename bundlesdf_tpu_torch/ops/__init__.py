"""Device ops: the hash-grid encoder, its CUDA scatter-add backward, the
occupancy grid and the ray samplers."""
