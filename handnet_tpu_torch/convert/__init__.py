"""Weight conversion into the port (``from_flax``)."""
