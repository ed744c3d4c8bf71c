"""Models of the port: FCOS detector, A2J pose regressor, fused pipeline."""
