"""Model text: trees and the loaded boosted forest."""
