"""Host-side helpers the port's simulator copy shares (``ioutil``)."""
