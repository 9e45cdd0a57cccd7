"""Model configuration, parameters and the two towers."""
