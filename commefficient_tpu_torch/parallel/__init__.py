"""Wire crossings of the sketch table (single device so far)."""
