"""Step builders.  Only the serving ones (prefill and decode) are ported;
the training step comes with the training slice."""
