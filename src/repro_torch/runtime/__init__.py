"""Runtime support of the port: fault injection (`faultinject`)."""
