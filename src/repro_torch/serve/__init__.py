"""The batched LM serving engine."""
