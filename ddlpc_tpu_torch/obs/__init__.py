"""Observability: the lineage record a checkpoint carries."""
