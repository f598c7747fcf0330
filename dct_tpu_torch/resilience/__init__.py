"""Resilience: the retry policy (the rest is ROADMAP Queue A item 28)."""
