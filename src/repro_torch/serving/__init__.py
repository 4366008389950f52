"""Serving front-ends of the port: `InferenceServer` (server.py) and the
offload runtime + one-shot `ServingEngine` (engine.py)."""
