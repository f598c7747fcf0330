"""Deployment: packaging, the rollout state machine and the endpoint clients."""
