"""Host-side evaluation helpers (so far the backbone trajectory container)."""
