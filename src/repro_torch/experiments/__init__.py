"""Experiments of the paper on the port (`paper`: Figs 2-10, Tables 3-4
and Theorem 2)."""
