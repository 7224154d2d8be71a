"""Codecs of the port: the QMF codec and its byte container."""
