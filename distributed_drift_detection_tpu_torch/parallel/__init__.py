"""The single-device half of the partition runner and its collect epilogue."""
