"""utils — the solver trace logger and rollouts."""
