"""Incremental Structure-from-Motion (Phase 1) on the card."""
