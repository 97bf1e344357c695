"""The benchmark's own tests (CPU, and the card where marked)."""
