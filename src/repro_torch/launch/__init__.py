"""Launchers of the LM stack: step factories and the decode server."""
