"""Parameter-tree helpers of the port."""
