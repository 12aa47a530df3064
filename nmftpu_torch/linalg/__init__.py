"""Dense linear-algebra update rules and error metrics (plain torch)."""
