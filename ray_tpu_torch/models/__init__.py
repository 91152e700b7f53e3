"""Models of the port (the GPT family's dense inference path)."""
