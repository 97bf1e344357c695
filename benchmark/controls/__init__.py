"""Readings that set the limits of the comparison, on the card."""
