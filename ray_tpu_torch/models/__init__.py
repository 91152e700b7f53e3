"""Models of the port: ``gpt`` (the GPT family) and ``llama`` (the Llama
family), each with its forward, loss and rematerialisation for serving
and training; the rest of the JAX package's zoo, ``diffusion`` (the UNet
and its DDIM sampler), ``vit``, ``bert`` and ``t5``; and ``_params``,
which carries any of them to and from the JAX package's parameter tree."""
