"""Deterministic, resumable synthetic data pipeline."""
