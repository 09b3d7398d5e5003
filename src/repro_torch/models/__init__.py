"""Models of the port (dense decoder stacks so far)."""
