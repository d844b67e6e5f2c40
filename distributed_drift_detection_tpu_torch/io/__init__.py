"""Host stream construction: synthetic generators, stripers."""
