"""Device helpers, and the host utilities of the stack: timers, metrics and
the MAC pcap writer."""
