"""Sharded AdamW and learning-rate schedules."""
