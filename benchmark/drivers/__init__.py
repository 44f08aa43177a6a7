"""Drivers: how a traffic file's cells run the program."""
