"""utils — the solver trace logger."""
