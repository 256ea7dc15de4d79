"""OpenAI-compatible serving: the chat server and its request batcher."""
