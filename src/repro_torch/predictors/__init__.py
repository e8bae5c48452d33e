"""Port of ``repro.predictors``: so far only the property-service tier
that serving needs (``service.py``: oracle stub, degraded tier, retries)."""
