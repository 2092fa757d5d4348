"""Per-cell operation counts of the port's kernel cases (data), and the
tool that counted them."""
