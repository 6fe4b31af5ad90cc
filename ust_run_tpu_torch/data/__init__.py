"""Dataset manifests, host decode cache, batch sampling (framework-free)."""
