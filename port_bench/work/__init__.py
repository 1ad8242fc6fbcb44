"""Work counts from shapes: the FLOPs of a forward pass and the least time of a kernel's work."""
