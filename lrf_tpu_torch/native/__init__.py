"""The port's native (C++) fiber codec, built with g++ at first use."""
