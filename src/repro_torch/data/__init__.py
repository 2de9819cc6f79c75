"""The deterministic token pipeline (``pipeline``)."""
