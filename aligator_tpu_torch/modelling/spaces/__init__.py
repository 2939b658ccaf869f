"""State spaces (Lie groups)."""
