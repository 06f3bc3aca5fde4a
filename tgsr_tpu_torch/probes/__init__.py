"""Probes: entry points that measure one question on the card."""
