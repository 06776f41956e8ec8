"""Native host library of the port: the slot parser, the key hash, the
xbox dump writer and the AUC's finalisation."""
