"""The Kubernetes object views, API-error helpers, Event recorder and
minimal REST client the GPU device class, the monitor and the slice gang
need. The operator passes in its own client and objects; the port reads
them by duck typing and imports none of the operator's code. The monitor,
run as a pod, builds its own ``rest.RestClient``."""
