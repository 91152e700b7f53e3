"""Models of the port: ``gpt`` (the GPT family) and ``llama`` (the Llama
family), each with its forward, loss and rematerialisation for serving
and training."""
