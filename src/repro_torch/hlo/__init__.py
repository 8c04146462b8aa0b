"""Work, traffic and roofline arithmetic of the port's programs (the twins
of `repro.hlo`): counted on a dry run over ``meta`` tensors, where JAX's
package parses the compiled HLO."""
