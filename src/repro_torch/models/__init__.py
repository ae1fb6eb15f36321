"""Model layers, stacks and the paged model API."""
