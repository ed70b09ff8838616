"""The harness: finds cells by name, checks the card, reduces traces and prints the result."""
