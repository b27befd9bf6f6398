"""Input preprocessing and the data sources."""
