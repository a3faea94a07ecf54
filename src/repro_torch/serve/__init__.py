"""The serving engine: decode batcher and tier-walk request loop."""
