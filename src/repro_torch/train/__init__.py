"""Training and serving step builders (``step``), AdamW (``optim``) and
the step-time watchdog (``watchdog``)."""
