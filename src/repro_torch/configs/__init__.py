"""Port of ``repro.configs``: so far only the scenario registry
(``scenarios.py``)."""
