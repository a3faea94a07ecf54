"""Durable byte custody.  Only the in-memory backend is ported so far;
the segment log waits for the durable slice."""
