"""Serving path of the port: E2EModel, InferenceServer, weight conversion."""
