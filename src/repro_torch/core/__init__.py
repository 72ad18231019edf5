"""The decoder: host planner, plain decode stages, Jacobi sync and the API."""
