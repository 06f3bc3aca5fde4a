"""Generator and text-encoder modules."""
