"""Seed-table suffix filter and the align pipeline."""
