"""The Stratus digit pipeline: deploy and serve the paper's CNN."""
