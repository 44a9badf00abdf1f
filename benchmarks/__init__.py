"""Benchmark and study scripts; `common` holds the shared ground truths."""
