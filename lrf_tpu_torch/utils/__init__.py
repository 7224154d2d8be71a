"""Device selection, transfers and quality metrics."""
