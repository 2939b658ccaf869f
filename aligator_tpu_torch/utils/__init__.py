"""utils — the solver trace logger, rollouts, MPC cycles, problem
interchange, NLP export, profiling ranges and plots."""
