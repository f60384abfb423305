"""The graph ops: plain functions on tensors registered under the JAX
package's names (``registry``), one module a family."""
