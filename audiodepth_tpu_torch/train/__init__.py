"""Tasks, optimizer and training engine of the port."""
