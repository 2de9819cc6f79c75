"""Distribution hooks the models call (one card: no mesh)."""
