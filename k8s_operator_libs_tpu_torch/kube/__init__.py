"""The few Kubernetes object views and API-error helpers the GPU device
class needs. The operator passes in its own client and objects; the port
reads them by duck typing and imports none of the operator's code."""
