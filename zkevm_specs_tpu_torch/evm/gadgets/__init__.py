"""Helper gadgets shared by execution gadgets."""
