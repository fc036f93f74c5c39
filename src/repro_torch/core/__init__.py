"""Privacy plane: circuits, garbling, the PiT protocol and sessions."""
