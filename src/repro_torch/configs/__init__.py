"""Model configs of the LM scaffold: ``base`` and one module per
architecture (``get_config`` imports them by id)."""
