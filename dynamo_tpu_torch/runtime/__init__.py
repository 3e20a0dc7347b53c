"""AsyncEngine, Context, ResponseStream."""
