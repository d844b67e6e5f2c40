"""The window engine and its containers."""
