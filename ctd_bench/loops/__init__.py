"""The cells' loops, one a kind of traffic (named by a mix's ``loop``)."""
