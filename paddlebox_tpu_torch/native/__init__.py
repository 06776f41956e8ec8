"""Native host library of the port: the slot parser and the key hash."""
