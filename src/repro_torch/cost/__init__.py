"""The paper's bandwidth cost models, the port of ``repro.cost``."""
