"""Static predictions over execution plans."""
