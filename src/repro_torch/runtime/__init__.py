"""Serving runtimes of the port: the classifier server
(`classify.ClassifyServer`) and the LM prefill/decode loop (`lm_serve`)."""
