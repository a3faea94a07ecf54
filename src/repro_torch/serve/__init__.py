"""The serving engine (decode batcher and tier-walk request loop) and
the event-loop serving runtime (``serve.runtime``)."""
